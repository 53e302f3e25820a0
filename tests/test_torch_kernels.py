"""Parity copy of the kernel-library cases of ``tests/test_kernels.py`` on
the port's CPU path, plus the int32 accumulator wrap and the Table-I
operand-stream recount, and the arithmetic of the toggle counters' CUDA
designs: K4 on K5's function, K1's and K2's packed high-word popcounts, and
K2's time runs against the reference's Pallas task kernel.

The port's entry points run with ``engine="torch"``: the plain PyTorch
versions of kernels K5 (toggle counting), K6 (the weight-stationary GEMM)
and K7 (fused attention), on the CPU.  On the same seeded numpy inputs they
must agree with the JAX package (Pallas in interpret mode).  Tolerances:

* counts and integer products: exact; activities are the same float
  division of equal integers, so they are equal too;
* float GEMMs (f32 sums of f32 or exact bf16 products): within
  1e-5 * (|a| @ |w|) elementwise, since the two packages add the K products
  in different orders and f32 rounding grows with the magnitudes summed,
  not with the result;
* attention: f32 within rtol 1e-5, atol 1e-5 (only the order of the sums
  differs); bf16 within rtol 5e-2, atol 5e-2, as ``tests/test_kernels.py``
  holds the reference to its oracle.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  All three packages share this one file, so their JAX
and PyTorch set-up is paid once.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.activity_profile.kernel import (
    activity_profile_pallas_tasks,
    stream_strips_toggles_pallas,
)
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.toggle_count.ops import stream_activity as ref_stream_activity
from repro.kernels.toggle_count.ops import stream_toggle_count as ref_stream_toggle_count
from repro.kernels.toggle_count.ops import (
    stream_toggle_count_i64 as ref_stream_toggle_count_i64,
)
from repro.kernels.ws_matmul.ops import ws_matmul as ref_ws_matmul
from repro_torch.core import pipeline
from repro_torch.core.pipeline import BatchStats, ProfileJob
from repro_torch.core.switching import stream_toggle_rate
from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job
from repro_torch.kernels._engine import CudaUnavailableError
from repro_torch.kernels.activity_profile import kernel as AK
from repro_torch.kernels.bitops import bus_mask, popcount64
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.toggle_count import (
    stream_activity,
    stream_toggle_count,
    stream_toggle_count_i64,
)
from repro_torch.kernels.toggle_count import kernel as TC
from repro_torch.kernels.toggle_count.ref import (
    popcount_u32_ref,
    stream_toggle_count_ref,
    toggle_count_ref,
)
from repro_torch.kernels.ws_matmul import kernel as WM
from repro_torch.kernels.ws_matmul import ws_matmul
from repro_torch.kernels.ws_matmul.ref import wrap_int32, ws_matmul_ref

from _torch_reference import REFERENCE_PATH

RNG = np.random.default_rng(0)
FLOAT_REL_TOL = 1e-5
F32_MAX = float(torch.finfo(torch.float32).max)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs in several worker processes at once, and some tests of
    other files time their work against a deadline: keep the plain
    versions' passes from taking every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# toggle_count (K5)
# ---------------------------------------------------------------------------


def _bits_of(x: np.ndarray, width: int) -> int:
    """Toggles along axis 0 of ``x``, counted with Python ints."""
    mask = (1 << width) - 1
    return sum(
        ((int(a) ^ int(b)) & mask).bit_count()
        for col in np.atleast_2d(x.T)
        for a, b in zip(col[:-1], col[1:])
    )


@pytest.mark.parametrize(
    "shape", [(2, 1), (17, 3), (100, 64), (257, 129), (512, 256), (1000, 7)]
)
def test_toggle_count_shapes(shape):
    s = RNG.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
    got = stream_toggle_count(s, engine="torch")
    assert got == ref_stream_toggle_count(jnp.asarray(s), interpret=True)
    assert got == int(stream_toggle_count_ref(torch.from_numpy(s)))


@pytest.mark.parametrize("bits", [8, 16, 32, 37, 48, 64])
def test_stream_activity_matches_reference(bits):
    vals = RNG.integers(-(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1, size=(60, 5))
    got = stream_activity(vals, bits=bits, engine="torch")
    assert got == ref_stream_activity(vals, bits=bits, interpret=True)
    assert got == pytest.approx(stream_toggle_rate(vals, bits=bits), abs=1e-12)


def test_toggle_count_i64_counts_all_64_bits():
    vals = RNG.integers(-(2**62), 2**62, size=(40, 3))
    got = stream_toggle_count_i64(vals, engine="torch")
    assert got == ref_stream_toggle_count_i64(vals, interpret=True)
    assert got == _bits_of(vals.view(np.uint64), 64)


def test_toggle_count_1d_and_degenerate():
    s = RNG.integers(0, 100, size=(50,), dtype=np.int32)
    got = stream_toggle_count(s, engine="torch")
    assert got == ref_stream_toggle_count(jnp.asarray(s), interpret=True)
    assert got == int(stream_toggle_count_ref(torch.from_numpy(s)[:, None]))
    assert stream_toggle_count(s[:1], engine="torch") == 0
    assert ref_stream_toggle_count(jnp.asarray(s[:1]), interpret=True) == 0
    assert stream_toggle_count_i64(s[:1], engine="torch") == 0
    assert stream_activity(s[:1], 16, engine="torch") == 0.0


def test_int64_stream_narrows_to_int32_as_the_reference():
    """``stream_toggle_count`` reads int32 words: wider values wrap first."""
    vals = RNG.integers(-(2**40), 2**40, size=(30, 4))
    got = stream_toggle_count(vals, engine="torch")
    assert got == ref_stream_toggle_count(jnp.asarray(vals.astype(np.int32)), interpret=True)
    assert got == _bits_of(vals.astype(np.int32).view(np.uint32), 32)


def test_toggle_oracle_pieces():
    x = torch.tensor([0, -1, 0x7FFFFFFF, -(2**31), 5], dtype=torch.int32)
    assert popcount_u32_ref(x).tolist() == [0, 32, 31, 1, 2]
    cur = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    nxt = torch.tensor([[0, 2], [0, 0]], dtype=torch.int32)
    assert int(toggle_count_ref(cur, nxt)) == 1 + 0 + 2 + 32


def test_int32_stream_on_a_wide_bus_counts_sign_copies():
    """An int32 stream on a bus wider than 32 bits is sign-extended, so it
    counts as its int64 copy does, without the widening copy."""
    vals = RNG.integers(-(2**31), 2**31, size=(50, 6))
    x32 = torch.from_numpy(vals.astype(np.int32))
    for bits in (16, 32, 37, 64):
        got = stream_activity(x32, bits, engine="torch")
        assert got == stream_activity(vals, bits, engine="torch")
        assert got == ref_stream_activity(vals, bits=bits, interpret=True)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_toggle_plain_windows_recompute_their_seed_rows(monkeypatch, dtype):
    x = torch.from_numpy(RNG.integers(-(2**31), 2**31, size=(103, 9))).to(dtype)
    whole = TC.stream_toggles_plain(x, 37)
    monkeypatch.setattr(TC, "PLAIN_BLOCK_ELEMENTS", 20)  # two time steps a window
    assert TC.stream_toggles_plain(x, 37).tolist() == whole.tolist()
    assert TC.stream_toggles(x, 37).tolist() == whole.tolist()


def test_toggle_count_contract():
    x = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        TC.stream_toggles(x.to(torch.int16))
    with pytest.raises(ValueError):
        TC.stream_toggles(x.t())  # not contiguous
    with pytest.raises(ValueError):
        TC.stream_toggles(x, 65)
    with pytest.raises(ValueError):
        TC.stream_toggles(x[0])
    before = TC.stream_toggles.launches
    assert TC.stream_toggles(x).tolist() == [0]
    assert TC.stream_toggles.launches == before  # CPU tensors run the plain version
    with pytest.raises(ValueError, match="unknown engine"):
        stream_toggle_count(np.zeros((3, 2), np.int32), engine="xla")


@pytest.mark.parametrize("shape", [(2, 1), (3, 5), (17, 3), (100, 64), (33, 129)])
def test_k4_and_k5_plain_versions_agree_on_int32_streams(shape):
    """K4 (``operand_stream_toggles``) and K5 (``stream_toggles``) compute one
    function on an int32 (T, L) stream: equal totals on every bus width,
    on ragged shapes, so K4's wrapper may launch K5's kernel."""
    x = torch.from_numpy(
        np.random.default_rng(list(shape)).integers(-(2**31), 2**31, size=shape).astype(np.int32)
    )
    for bits in range(1, 65):
        k4 = AK.operand_stream_toggles_plain(x, bits).tolist()
        assert k4 == TC.stream_toggles_plain(x, bits).tolist(), bits
        assert k4 == AK.operand_stream_toggles_plain(x, bits, block_t=4).tolist(), bits


def _packed_transition_toggles(d: torch.Tensor, bits: int, widths=(5, 8, 16, 32)) -> int:
    """A CPU rendering of the masked popcount of K1 and K2
    (``transitions<S>`` in ``csrc/toggles.cuh``) over rows of transition
    XORs ``d`` (int64), one row a thread's run (``AK.WS_KERNEL_STEPS`` for
    K1, ``AK.WS_TASK_STEPS`` or ``AK.WS_TASK_SHORT_STEPS`` for K2), on a
    ``bits``-wide bus, 32 < bits <= 64: one popcount of each low word, and
    the masked high words packed 32 // S to a word, S the smallest of
    ``widths`` that holds bits - 32 (K2 takes no S = 8)."""
    steps = d.shape[-1]
    assert 32 < bits <= 64
    hb = bits - 32
    width = next(s for s in widths if hb <= s)
    fields = 32 // width
    hi = (d >> 32) & bus_mask(hb)
    words = torch.zeros(d.shape[:-1] + (-(-steps // fields),), dtype=torch.int64)
    for j in range(steps):
        words[..., j // fields] += hi[..., j] << (j % fields * width)
    assert int(words.max()) < 2**32  # the fields fill at most one 32-bit word
    return int(popcount64(d & 0xFFFFFFFF).sum() + popcount64(words).sum())


@pytest.mark.parametrize("bits", range(33, 65))
def test_k1_packed_high_words_count_every_bit(bits):
    rng = np.random.default_rng(bits)
    d = torch.from_numpy(rng.integers(-(2**63), 2**63, size=(64, AK.WS_KERNEL_STEPS), dtype=np.int64))
    d[0] = -1  # every bit set
    assert _packed_transition_toggles(d, bits) == int(popcount64(d & bus_mask(bits)).sum())


@pytest.mark.parametrize("steps", [AK.WS_TASK_STEPS, AK.WS_TASK_SHORT_STEPS])
@pytest.mark.parametrize("bits", range(33, 65))
def test_k2_packed_high_words_count_every_bit(bits, steps):
    rng = np.random.default_rng([bits, steps])
    d = torch.from_numpy(rng.integers(-(2**63), 2**63, size=(64, steps), dtype=np.int64))
    d[0] = -1  # every bit set
    got = _packed_transition_toggles(d, bits, widths=(5, 16, 32))
    assert got == int(popcount64(d & bus_mask(bits)).sum())


_TASK_REFERENCE: dict = {}


def _task_bucket(t_seg: int):
    """A stacked WS bucket as the port's scheduler builds it, cut to
    ``t_seg`` steps a strip (16x8 array, b_v 37; K = 37 leaves K-padding
    rows), with a dummy task (valid_r 0) appended, and the reference's
    Pallas task kernel's counts on it, computed once per ``t_seg``."""
    if t_seg not in _TASK_REFERENCE:
        bucket_map, buckets, pass_map, stats = {}, [], {}, BatchStats()
        rng = np.random.default_rng(t_seg)
        for m, k, n in ((100, 37, 9), (70, 16, 13)):
            a = rng.integers(-32767, 32768, size=(m, k))
            w = rng.integers(-32767, 32768, size=(k, n))
            job = ProfileJob(rows=16, cols=8, b_h=16, b_v=37, a=a, w=w)
            pipeline._schedule_job(job, a, w, t_seg, bucket_map, buckets, pass_map, stats)
        (b,) = buckets
        assert b.t_seg == t_seg
        arrays = (
            np.stack(b.strips),
            np.stack(b.w_tiles),
            np.asarray(b.strip_ids + [0], np.int32),
            np.asarray(b.w_ids + [0], np.int32),
            np.asarray(b.valid_r + [0], np.int32),
        )
        want = np.asarray(
            activity_profile_pallas_tasks(*arrays, rows=16, cols=8, b_v=37, interpret=True)
        ).astype(np.int64)
        _TASK_REFERENCE[t_seg] = arrays, want.tolist()
    return _TASK_REFERENCE[t_seg]


@pytest.mark.parametrize("run_t", [8, 15, 16])
@pytest.mark.parametrize("t_seg", [8, 16, 128])
def test_k2_plain_in_time_runs_matches_reference_tasks(t_seg, run_t):
    """K2's plain version cut into runs of ``run_t`` transitions, each from
    its recomputed seed row (the kernel's threads: runs of 16 or 8; K1's
    15 for a run that does not divide t_seg), counts as the reference's
    Pallas task kernel does, task for task."""
    arrays, want = _task_bucket(t_seg)
    t = [torch.from_numpy(x) for x in arrays]
    assert want[-1] == 0 and (arrays[4][:-1] < 16).any()
    assert AK.ws_task_toggles_plain(*t, 37, run_t=run_t).tolist() == want
    assert AK.ws_task_toggles_plain(*t, 37, run_t=run_t, task_chunk=5).tolist() == want


# K3 at the edges of its column walk: lanes 1, 3 and 5 (scalar lanes; 5 is
# not a multiple of 4), 4 and 8 (16-byte groups), t1 = 2 (one transition),
# one strip and many, and strips of more than one time chunk.
K3_EDGES = [(1, 2, 1), (1, 2, 3), (3, 2, 5), (1, 9, 3), (4, 17, 5), (2, 40, 4), (7, 129, 8),
            (1, 300, 5)]


@pytest.mark.parametrize("bits", [16, 37, 64])
@pytest.mark.parametrize("shape", K3_EDGES)
def test_k3_plain_version_at_its_walk_edges(shape, bits):
    strips = RNG.integers(-32768, 32768, size=shape).astype(np.int32)
    got = AK.strip_toggles_plain(torch.from_numpy(strips), bits)
    want = np.asarray(stream_strips_toggles_pallas(strips, bits=bits, interpret=True))
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == [_bits_of(x.astype(np.int64), bits) for x in strips]


def test_table1_operand_streams_recount_the_reference():
    """K5's plain version recounts the horizontal (WS, OS) and vertical (OS)
    toggles of every Table-I layer from its operand streams: WS h =
    n_tiles x the toggles of A down M; OS h = n_tiles x those of A^T down
    K; OS v = m_tiles x those of W down K on the 16-bit bus.  Each must
    equal the JAX package's count in ``table1_reference.json``, and each
    stream's activity the reference profile's."""
    ref = json.loads(REFERENCE_PATH.read_text())
    rows, cols = ref["rows"], ref["cols"]
    for i, (layer, want) in enumerate(zip(RESNET50_TABLE1, ref["layers"])):
        a, w = conv_layer_job(layer, seed=i).operands()
        m, k = a.shape
        n = w.shape[1]
        n_tiles, m_tiles = -(-n // cols), -(-m // rows)
        assert 0 <= a.min() and a.max() < 2**15  # post-ReLU: the 32-bit count is the 16-bit one
        ws_h = n_tiles * stream_toggle_count(a, engine="torch")
        os_h = n_tiles * stream_toggle_count(np.ascontiguousarray(a.T), engine="torch")
        os_v = m_tiles * stream_toggle_count_i64(w & 0xFFFF, engine="torch")
        assert ws_h == want["WS"]["counts"][0], layer.name
        assert (os_h, os_v) == tuple(want["OS"]["counts"][:2]), layer.name
        assert stream_activity(a, 16, engine="torch") == want["WS"]["profile"]["a_h"]
        assert stream_activity(w, 16, engine="torch") == want["OS"]["profile"]["a_v"]


# ---------------------------------------------------------------------------
# ws_matmul (K6)
# ---------------------------------------------------------------------------


def _bf16(x: np.ndarray) -> tuple[torch.Tensor, jnp.ndarray]:
    """The same bfloat16 values for both packages (rounded once, by torch)."""
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize(
    "m,k,n",
    [(128, 128, 128), (1, 1, 1), (200, 300, 170), (127, 129, 255), (384, 256, 512)],
)
@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_ws_matmul_int_exact(m, k, n, dtype):
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -1000), min(info.max, 1000)
    a = RNG.integers(lo, hi, size=(m, k)).astype(dtype)
    w = RNG.integers(lo, hi, size=(k, n)).astype(dtype)
    got = ws_matmul(a, w, engine="torch")
    want = np.asarray(ref_ws_matmul(jnp.asarray(a), jnp.asarray(w), interpret=True))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ws_matmul_ref(torch.from_numpy(a), torch.from_numpy(w)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(130, 260, 140), (64, 512, 64)])
def test_ws_matmul_float_close(dtype, m, k, n):
    a_np, w_np = RNG.normal(size=(m, k)), RNG.normal(size=(k, n))
    if dtype == "bfloat16":
        (a, a_j), (w, w_j) = _bf16(a_np), _bf16(w_np)
    else:
        a, w = a_np.astype(np.float32), w_np.astype(np.float32)
        a_j, w_j = jnp.asarray(a), jnp.asarray(w)
    got = ws_matmul(a, w, engine="torch")
    assert got.dtype == torch.float32
    scale = np.abs(np.asarray(a_j, np.float64)) @ np.abs(np.asarray(w_j, np.float64))
    want = ref_ws_matmul(a_j, w_j, interpret=True)
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    assert (err <= FLOAT_REL_TOL * scale).all(), float((err / scale).max())


def test_ws_matmul_block_shapes():
    """The reference gives one answer at every block shape; the port, which
    has no block arguments, gives the same."""
    a = RNG.integers(-50, 50, size=(100, 90)).astype(np.int8)
    w = RNG.integers(-50, 50, size=(90, 60)).astype(np.int8)
    got = ws_matmul(a, w, engine="torch").numpy()
    for bm, bn, bk in [(32, 32, 32), (64, 128, 32), (128, 64, 64)]:
        want = ref_ws_matmul(
            jnp.asarray(a), jnp.asarray(w), block_m=bm, block_n=bn, block_k=bk, interpret=True
        )
        assert np.array_equal(got, np.asarray(want))


def test_int16_accumulator_wraps_like_the_reference():
    """Sums of 260 int16 products beyond 2^31 wrap mod 2^32 in both
    packages, exactly as an int32 accumulator does."""
    m, k, n = 130, 260, 129
    a = np.full((m, k), 32767, dtype=np.int16)
    a[::3] = -32767
    w = RNG.choice(np.array([-32767, 32767], dtype=np.int16), size=(k, n))
    w[:, 0] = 32767
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2**31  # the case really leaves the int32 range
    got = ws_matmul(a, w, engine="torch").numpy()
    want = np.asarray(ref_ws_matmul(jnp.asarray(a), jnp.asarray(w), interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, exact.astype(np.int32))  # numpy's astype wraps mod 2^32
    assert np.array_equal(got, wrap_int32(torch.from_numpy(exact)).numpy())


def test_gemm_plain_version_chunks_the_reduction_exactly(monkeypatch):
    a = torch.from_numpy(RNG.integers(-32767, 32768, size=(33, 70))).to(torch.int16)
    w = torch.from_numpy(RNG.integers(-32767, 32768, size=(70, 19))).to(torch.int16)
    whole = WM.ws_gemm_plain(a, w)
    monkeypatch.setattr(WM, "EXACT_CHUNK_K", 8)
    assert torch.equal(WM.ws_gemm_plain(a, w), whole)
    assert torch.equal(whole, ws_matmul_ref(a, w))


def test_ws_matmul_contract():
    a = np.ones((4, 3), np.int16)
    with pytest.raises(ValueError, match="bad shapes"):
        ws_matmul(a, np.ones((4, 2), np.int16), engine="torch")
    with pytest.raises(TypeError):
        ws_matmul(a, np.ones((3, 2), np.int8), engine="torch")  # mixed types
    with pytest.raises(TypeError):
        ws_matmul(a.astype(np.int32), np.ones((3, 2), np.int32), engine="torch")
    with pytest.raises(ValueError, match="unknown engine"):
        ws_matmul(a, np.ones((3, 2), np.int16), engine="xla")
    before = WM.ws_gemm.launches
    assert ws_matmul(a, np.ones((3, 2), np.int16), engine="torch").tolist() == [[3, 3]] * 4
    assert WM.ws_gemm.launches == before  # CPU tensors run the plain version


def test_operand_planes_recover_every_int16_value():
    """hi * 2^8 + lo (hi read as s8, lo as u8) gives back each of the 65536
    int16 values; the int8 plane is the values; K pads with zeros to a
    multiple of PLANE_K and w is transposed."""
    values = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).reshape(256, 256)
    a_planes, w_planes = WM.gemm_operand_planes(values, values.t().contiguous())
    assert a_planes.shape == w_planes.shape == (2, 256, 256) and a_planes.dtype == torch.int8
    for planes in (a_planes, w_planes):
        hi, lo = planes[0].long(), planes[1].view(torch.uint8).long()
        assert torch.equal(hi * 256 + lo, values.long())
    a = torch.from_numpy(RNG.integers(-128, 128, size=(5, 33))).to(torch.int8)
    w = torch.from_numpy(RNG.integers(-128, 128, size=(33, 3))).to(torch.int8)
    a_planes, w_planes = WM.gemm_operand_planes_plain(a, w)
    assert a_planes.shape == (1, 5, 64) and w_planes.shape == (1, 3, 64)
    assert torch.equal(a_planes[0, :, :33], a) and not a_planes[0, :, 33:].any()
    assert torch.equal(w_planes[0, :, :33], w.t()) and not w_planes[0, :, 33:].any()


def _planes_product(a, w, k_splits=1):
    """The tensor-core route's integer arithmetic on the plain planes: per
    split of K, hh, then D * 2^8 + hl + lh, then D * 2^8 + ll, each step
    wrapped to int32; the splits' sums added and wrapped."""
    a_planes, w_planes = (x.long() for x in WM.gemm_operand_planes_plain(a, w))
    if a.dtype == torch.int16:  # the lo plane is read as u8
        a_planes[1] &= 0xFF
        w_planes[1] &= 0xFF
    kp = a_planes.shape[2]
    total = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64)
    for ks in torch.arange(kp).chunk(k_splits):
        ah, al = a_planes[0][:, ks], a_planes[-1][:, ks]
        wh, wl = w_planes[0][:, ks], w_planes[-1][:, ks]
        if a.dtype == torch.int8:
            d = wrap_int32(ah @ wh.t()).long()
        else:
            d = wrap_int32(ah @ wh.t()).long()
            d = wrap_int32(d * 256 + ah @ wl.t() + al @ wh.t()).long()
            d = wrap_int32(d * 256 + al @ wl.t()).long()
        total = wrap_int32(total + d).long()
    return total.to(torch.int32)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (127, 129, 255), (200, 300, 170), (33, 70, 19)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("k_splits", [1, 3])
def test_planes_recombine_to_the_plain_product(m, k, n, dtype, k_splits):
    info = torch.iinfo(dtype)
    a = torch.from_numpy(RNG.integers(info.min, info.max + 1, size=(m, k))).to(dtype)
    w = torch.from_numpy(RNG.integers(info.min, info.max + 1, size=(k, n))).to(dtype)
    assert torch.equal(_planes_product(a, w, k_splits), WM.ws_gemm_plain(a, w))


@pytest.mark.parametrize("k_splits", [1, 4])
def test_planes_recombine_through_the_wrap(k_splits):
    a = torch.full((130, 260), 32767, dtype=torch.int16)
    a[::3] = -32767
    w = torch.from_numpy(RNG.choice([-32767, 32767], size=(260, 129))).to(torch.int16)
    exact = a.long() @ w.long()
    assert exact.abs().max() > 2**31
    got = _planes_product(a, w, k_splits)
    assert torch.equal(got, wrap_int32(exact)) and torch.equal(got, WM.ws_gemm_plain(a, w))


@pytest.mark.parametrize(
    "dtype,k,n,route",
    [
        (torch.int8, 129, 7, "tc"),
        (torch.int8, 1, 1, "tc"),
        (torch.int16, 300, 170, "tc"),
        (torch.bfloat16, 64, 64, "tc"),
        (torch.bfloat16, 8, 8, "tc"),
        (torch.bfloat16, 260, 140, "tf32"),
        (torch.bfloat16, 264, 130, "tf32"),
        (torch.bfloat16, 7, 1, "tf32"),
        (torch.float32, 64, 64, "tf32"),
        (torch.float32, 3, 300, "tf32"),
        (torch.float32, 33, 129, "tf32"),
    ],
)
def test_gemm_route_by_type_and_strides(dtype, k, n, route):
    assert WM.gemm_route(dtype, 33, k, n) == route
    assert WM.gemm_route(dtype, 1, k, n) == route  # M never decides


def test_gemm_routes_on_cpu_tensors_run_the_plain_version():
    a = torch.from_numpy(RNG.integers(-300, 300, size=(9, 16))).to(torch.int16)
    w = torch.from_numpy(RNG.integers(-300, 300, size=(16, 8))).to(torch.int16)
    before = {attr: getattr(WM.ws_gemm, attr)
              for attr in ("launches", "tc_launches", "tf32_launches", "prep_launches")}
    for x, y in ((a, w), (a.float(), w.float()), (a.bfloat16(), w.bfloat16())):
        assert WM.gemm_route(x.dtype, 9, 16, 8) == ("tf32" if x.dtype == torch.float32 else "tc")
        assert torch.equal(WM.ws_gemm(x, y), WM.ws_gemm_plain(x, y))
        planes = WM.gemm_operand_planes(x, y)
        assert all(torch.equal(p, q) for p, q in zip(planes, WM.gemm_operand_planes_plain(x, y)))
    assert torch.equal(WM.ws_gemm(a, w), ws_matmul_ref(a, w))
    assert all(getattr(WM.ws_gemm, attr) == n for attr, n in before.items())
    with pytest.raises(TypeError):
        WM.gemm_route(torch.int32, 1, 1, 1)
    with pytest.raises(TypeError):
        WM.gemm_operand_planes(a.int(), w.int())


# The f32 route's planes: x = big + small + r, each of big and small a TF32
# value (an f32 whose low 13 mantissa bits are zero), |r| <= 2^-22 |x|
# where small is a normal f32 (|x| >= 2^-115), else |r| <= 2^-137, half the
# step of a subnormal TF32 value. Cases: seeded normal values at several
# scales, values near f32's largest (whose big must not round to inf) and
# near its smallest normal (where small is subnormal).
TF32_CASES = {
    "normal": lambda shape: RNG.normal(size=shape),
    "wide exponents": lambda shape: RNG.normal(size=shape) * 2.0 ** RNG.integers(-60, 60, size=shape),
    "near the maximum": lambda shape: F32_MAX * RNG.uniform(0.5, 1.0, size=shape),
    "near the smallest normal": lambda shape: 1.2e-38 * RNG.uniform(1.0, 4.0, size=shape),
}


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_tf32_planes_split_every_value(case):
    a = torch.from_numpy(TF32_CASES[case]((37, 45)).astype(np.float32))
    a[0, :4] = torch.tensor([F32_MAX, -F32_MAX, 0.0, -0.0])
    w = torch.from_numpy(TF32_CASES[case]((45, 5)).astype(np.float32))
    a_planes, w_planes = WM.gemm_operand_planes_plain(a, w)
    assert a_planes.shape == (2, 37, 64) and w_planes.shape == (2, 5, 64)
    assert a_planes.dtype == w_planes.dtype == torch.float32
    for planes, x in ((a_planes, a), (w_planes, w.t())):
        assert not planes[:, :, 45:].any()  # K padded with zeros
        big, small = planes[:, :, :45].double()
        assert torch.isfinite(big).all() and torch.isfinite(small).all()
        for part in planes:
            assert not (part.view(torch.int32) & 0x1FFF).any()  # TF32 values
        x = x.double()
        assert ((x - big - small).abs() <= (2.0**-22 * x.abs()).clamp(min=2.0**-137)).all()
        assert ((x - big).abs() <= 2.0**-10 * x.abs()).all()
    # rounding to nearest, ties away from zero, on the bits
    ties = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-11 - 2**-23], dtype=torch.float32)
    assert WM.round_tf32(ties).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0]


def test_tf32_planes_carry_non_finite_values_in_small():
    """inf and NaN go whole into small and big keeps their sign as +-1 (with
    small = 0 a_b.w_s would be inf * 0 = NaN for every w that TF32 holds
    exactly); bf16 takes one plane, its values, which TF32 holds exactly."""
    a = torch.tensor([[np.inf, -np.inf, np.nan, 1.5]], dtype=torch.float32)
    w = torch.ones((4, 1))
    (big, small), _ = WM.gemm_operand_planes_plain(a, w)
    assert big[0, :4].tolist() == [1.0, -1.0, 1.0, 1.5]
    assert small[0, :3].isinf().tolist() == [True, True, False] and small[0, 2].isnan()
    assert small[0, :2].tolist() == [np.inf, -np.inf] and small[0, 3] == 0
    b = torch.from_numpy(RNG.normal(size=(9, 7))).to(torch.bfloat16)
    a_planes, w_planes = WM.gemm_operand_planes_plain(b, b.t().contiguous())
    assert a_planes.shape == w_planes.shape == (1, 9, 32) and a_planes.dtype == torch.float32
    assert torch.equal(a_planes[0, :, :7], b.float()) and torch.equal(w_planes[0, :, :7], b.float())
    assert not (a_planes.view(torch.int32) & 0x1FFF).any()


def _three_products(a, w):
    """The f32 route's arithmetic on the plain planes, in float64:
    a_s.w_b + a_b.w_s + a_b.w_b."""
    (ab, as_), (wb, ws) = (x.double() for x in WM.gemm_operand_planes_plain(a, w))
    return as_ @ wb.t() + ab @ ws.t() + ab @ wb.t()


@pytest.mark.parametrize("case", ["normal", "wide exponents", "near the maximum"])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (130, 7, 129), (33, 300, 40)])
def test_three_tf32_products_meet_the_f32_tolerance(case, m, k, n):
    a = TF32_CASES[case]((m, k)).astype(np.float32)
    w = TF32_CASES[case]((k, n)).astype(np.float32)
    if case == "near the maximum":
        w = (w / F32_MAX * 2.0**-20).astype(np.float32)  # finite products
    got = _three_products(torch.from_numpy(a), torch.from_numpy(w))
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(a.astype(np.float64)) @ np.abs(w.astype(np.float64))
    assert np.isfinite(got.numpy()).all()
    assert (np.abs(got.numpy() - exact) <= FLOAT_REL_TOL * scale).all()
    one = (a.astype(np.float64) @ WM.round_tf32(torch.from_numpy(w)).double().numpy())
    if case == "normal" and k > 100:  # one TF32 product alone would not
        assert not (np.abs(one - exact) <= FLOAT_REL_TOL * scale).all()


def test_three_tf32_products_lose_bits_below_2_to_the_minus_120():
    """The route's known limit: below 2^-115 small is subnormal, and below
    about 2^-120 the dropped bits (up to 2^-137 a value) exceed 1e-5 of the
    value, so products of such values miss the f32 tolerance (they stay
    within 2^-137 * |w| a term)."""
    a = (1.2e-38 * RNG.uniform(1.0, 4.0, size=(9, 40))).astype(np.float32)
    w = RNG.normal(size=(40, 6)).astype(np.float32)
    got = _three_products(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(a.astype(np.float64)) @ np.abs(w.astype(np.float64))
    assert not (np.abs(got - exact) <= FLOAT_REL_TOL * scale).all()
    assert (np.abs(got - exact) <= 2.0**-137 * (np.abs(w).sum(axis=0) * 3)).all()


def test_three_tf32_products_give_inf_and_nan_as_f32():
    a = torch.tensor([[np.inf, 1.0], [-np.inf, 1.0], [np.nan, 1.0], [0.0, 1.0], [np.inf, 0.0]])
    w = torch.tensor([[1.0, 0.0, -2.5, np.inf], [1.0, 1.0, 1.0, 1.0]])
    want = a @ w
    got = _three_products(a, w).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


# ---------------------------------------------------------------------------
# flash_attention (K7)
# ---------------------------------------------------------------------------


def _qkv(b, h, kv, s, d):
    return (
        RNG.normal(size=(b, h, s, d)).astype(np.float32),
        RNG.normal(size=(b, kv, s, d)).astype(np.float32),
        RNG.normal(size=(b, kv, s, d)).astype(np.float32),
    )


def _reference(q, k, v, **kw):
    return np.asarray(
        ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    )


@pytest.mark.parametrize(
    "b,h,kv,s,d", [(1, 1, 1, 128, 64), (2, 4, 2, 200, 64), (1, 8, 1, 256, 128)]
)
def test_flash_causal_gqa(b, h, kv, s, d):
    q, k, v = _qkv(b, h, kv, s, d)
    got = flash_attention(q, k, v, causal=True, engine="torch")
    np.testing.assert_allclose(got.numpy(), _reference(q, k, v, causal=True), **F32_TOL)


@pytest.mark.parametrize("window", [16, 64, 128])
def test_flash_sliding_window(window):
    q, k, v = _qkv(1, 2, 2, 256, 64)
    got = flash_attention(q, k, v, causal=True, window=window, engine="torch")
    want = _reference(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_bf16():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, 2, 1, 128, 64))
    got = flash_attention(q, k, v, causal=True, engine="torch")
    assert got.dtype == torch.bfloat16
    want = ref_flash_attention(
        *(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in (q, k, v)),
        causal=True,
        interpret=True,
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_flash_block_size_invariance():
    """The reference gives one answer at both block shapes; the port, which
    has no block arguments, gives the same."""
    q, k, v = _qkv(1, 2, 2, 512, 64)
    got = flash_attention(q, k, v, engine="torch").numpy()
    np.testing.assert_allclose(got, _reference(q, k, v, block_q=128, block_k=128), **F32_TOL)
    np.testing.assert_allclose(got, _reference(q, k, v, block_q=64, block_k=256), **F32_TOL)


@pytest.mark.parametrize("window", [None, 64])
def test_flash_noncausal(window):
    q, k, v = _qkv(1, 2, 1, 256, 32)
    got = flash_attention(q, k, v, causal=False, window=window, engine="torch")
    want = _reference(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_rows_that_see_no_key_give_zeros():
    q, k, v = _qkv(1, 2, 2, 128, 64)
    got = flash_attention(q, k, v, causal=True, window=0, engine="torch")
    assert not got.any()
    np.testing.assert_array_equal(got.numpy(), _reference(q, k, v, causal=True, window=0))


def test_attention_oracle_matches_the_reference_oracle():
    q, k, v = (x[0] for x in _qkv(1, 3, 3, 96, 32))
    for kw in (dict(causal=True), dict(causal=True, window=20), dict(causal=False, sm_scale=0.3)):
        got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
        want = jax_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_attention_plain_version_chunks_the_queries(monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 150, 32))
    whole = FA.flash_attention_fwd_plain(q, k, v, window=40)
    chunked = FA.flash_attention_fwd_plain(q, k, v, window=40, query_chunk=37)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **F32_TOL)
    grouped = torch.stack(
        [attention_ref(q[:, i], k[:, i // 2], v[:, i // 2], window=40) for i in range(4)], 1
    )
    np.testing.assert_allclose(whole.numpy(), grouped.numpy(), **F32_TOL)


def test_flash_attention_contract():
    q, k, v = _qkv(1, 4, 3, 128, 64)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        flash_attention(q, k, v, engine="torch")
    q, k, v = _qkv(1, 2, 1, 200, 64)
    with pytest.raises(ValueError, match="block-multiple seq"):
        flash_attention(q, k, v, causal=False, engine="torch")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48], k[..., :48], v[..., :48], engine="torch")
    with pytest.raises(TypeError):
        flash_attention(q, k.astype(np.float16), v, engine="torch")
    before = FA.flash_attention_fwd.launches
    flash_attention(q, k, v, engine="torch")
    assert FA.flash_attention_fwd.launches == before  # CPU tensors run the plain version


def _tensor_core_rendering(q, k, v, *, window=None, split=True, tile=128):
    """The tensor-core kernel's arithmetic in plain PyTorch: causal online
    softmax over key tiles of ``tile`` in the log2 domain, the unnormalised
    weights P rounded to bf16 (``split``: as hi + lo, two bf16 terms)
    before P V, f32 sums, the result rounded to bf16."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(rep, 1) for x in (k, v))
    c = d ** -0.5 * 1.4426950408889634
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -1.0e30)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, d))
    for k0 in range(0, s, tile):
        keys = torch.arange(k0, min(k0 + tile, s))[None]
        x = (qf @ kf[:, :, k0 : k0 + tile].transpose(-1, -2)) * c
        hidden = keys > rows
        if window is not None:
            hidden |= rows - keys >= window
        x = x.masked_fill(hidden, float("-inf"))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        p_mma = hi + (p - hi).to(torch.bfloat16).float() if split else hi
        o = o * alpha + p_mma @ vf[:, :, k0 : k0 + tile]
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)).to(torch.bfloat16)


@pytest.mark.parametrize("d,window", [(128, None), (64, 300), (32, None)])
def test_tensor_core_attention_error_budget(d, window):
    """At S=1000, H=8, KV=2 the tensor-core design (P as hi + lo bf16)
    stays within the card's bf16 tolerance (rtol 1.6e-2, atol 1e-3) of the
    plain version; one bf16 rounding of P would not, on rows that see few
    keys, which is why the kernel carries the second term."""
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, heads, 1000, d, generator=gen).to(torch.bfloat16) for heads in (8, 2, 2))
    plain = FA.flash_attention_fwd_plain(q, k, v, window=window).float()

    def beyond(got):
        return int(((got.float() - plain).abs() > 1e-3 + 1.6e-2 * plain.abs()).sum())

    assert beyond(_tensor_core_rendering(q, k, v, window=window)) == 0
    assert beyond(_tensor_core_rendering(q, k, v, window=window, split=False)) > 0


def test_attention_routes_on_cpu_tensors_run_the_plain_version():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 4, 2, 70, 32))
    before = {attr: getattr(FA.flash_attention_fwd, attr)
              for attr in ("launches", "tc_launches", "tf32_launches", "prep_launches")}
    want = FA.flash_attention_fwd_plain(q, k, v, window=20)
    assert torch.equal(FA.flash_attention_fwd(q, k, v, window=20), want)
    q, k, v = (x.float() for x in (q, k, v))
    assert torch.equal(FA.flash_attention_fwd(q, k, v, window=20),
                       FA.flash_attention_fwd_plain(q, k, v, window=20))
    planes = FA.attention_operand_planes(k, v)
    assert all(torch.equal(p, q) for p, q in zip(planes, FA.attention_operand_planes_plain(k, v)))
    assert all(getattr(FA.flash_attention_fwd, attr) == n for attr, n in before.items())
    assert FA.attention_route(torch.bfloat16) == "tc" and FA.attention_route(torch.float32) == "tf32"
    with pytest.raises(TypeError):
        FA.attention_route(torch.float16)
    with pytest.raises(TypeError):
        FA.attention_operand_planes(k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        FA.attention_operand_planes(k, v[:, :, :10])


# The f32 route's operand planes: K's TF32 big and small planes as they are,
# V's transposed with the keys of each group of 8 in KEY_ORDER and zeros
# past S; split as K6's f32 planes are.
ATTENTION_PLANE_SHAPES = [(1, 1, 1, 32), (2, 3, 70, 64), (1, 2, 64, 128), (1, 1, 33, 32)]


def _unpermuted_v(vt_planes, s):
    """V's (2, B·KV, S, D) planes from V^T's, KEY_ORDER undone and the
    padding dropped."""
    p, bkv, d, sp = vt_planes.shape
    inverse = list(np.argsort(FA.KEY_ORDER))
    vt = vt_planes.reshape(p, bkv, d, sp // 8, 8)[..., inverse].reshape(p, bkv, d, sp)
    return vt[..., :s].transpose(-1, -2)


@pytest.mark.parametrize("b,kv,s,d", ATTENTION_PLANE_SHAPES)
def test_attention_operand_planes_shapes_and_padding(b, kv, s, d):
    k, v = (torch.from_numpy(RNG.normal(size=(b, kv, s, d)) * 2.0 ** RNG.integers(-30, 30, size=(b, kv, s, d)))
            .float() for _ in range(2))
    k_planes, vt_planes = FA.attention_operand_planes_plain(k, v)
    sp = -(-s // FA.PLANE_KEYS) * FA.PLANE_KEYS
    assert k_planes.shape == (2, b * kv, s, d) and vt_planes.shape == (2, b * kv, d, sp)
    assert k_planes.dtype == vt_planes.dtype == torch.float32
    for planes in (k_planes, vt_planes):
        assert not (planes.view(torch.int32) & 0x1FFF).any()  # TF32 values
    # zeros past S, wherever KEY_ORDER put them
    assert not _unpermuted_v(vt_planes, sp)[:, :, s:].any()
    # K's planes are K6's planes of the same values, bit for bit
    a_planes, _ = WM.gemm_operand_planes_plain(k.reshape(-1, d), torch.zeros((d, 1)))
    assert torch.equal(k_planes.reshape(2, -1, d).view(torch.int32), a_planes.view(torch.int32))


@pytest.mark.parametrize("b,kv,s,d", ATTENTION_PLANE_SHAPES)
def test_attention_vt_key_order_undone_gives_v(b, kv, s, d):
    k, v = (torch.from_numpy(RNG.normal(size=(b, kv, s, d))).float() for _ in range(2))
    _, vt_planes = FA.attention_operand_planes_plain(k, v)
    v_planes = _unpermuted_v(vt_planes, s)
    x = v.reshape(b * kv, s, d).double()
    big, small = v_planes.double()
    assert ((x - big - small).abs() <= 2.0**-22 * x.abs()).all()
    # bit for bit K6's planes of the same values (V as the GEMM's w: K6
    # transposes it, as the prep does)
    for z in range(b * kv):
        _, w_planes = WM.gemm_operand_planes_plain(torch.zeros((1, s)), v.reshape(b * kv, s, d)[z])
        assert torch.equal(w_planes[:, :, :s].view(torch.int32),
                           v_planes[:, z].transpose(-1, -2).contiguous().view(torch.int32))
    assert tuple(sorted(FA.KEY_ORDER)) == tuple(range(8))


def _tf32_attention(q, k, v, *, causal=True, window=None, three=True):
    """The f32 route's arithmetic on the plain planes, in float64: S = Q_s
    K_b + Q_b K_s + Q_b K_b; the softmax; P rounded to f32 and split into
    TF32 big and small; O = P_s V_b + P_b V_s + P_b V_b, normalised (with
    ``three`` False, one TF32 product each: Q_b K_b and P_b V_b)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    k_planes, vt_planes = FA.attention_operand_planes_plain(k, v)
    q_b, q_s = WM.tf32_planes(q).double()
    k_b, k_s = k_planes.double().reshape(2, b, kv, s, d).repeat_interleave(h // kv, 2)
    v_b, v_s = _unpermuted_v(vt_planes, s).double().reshape(2, b, kv, s, d).repeat_interleave(h // kv, 2)
    if not three:
        q_s, k_s, v_s = (torch.zeros_like(x) for x in (q_s, k_s, v_s))
    logits = (q_s @ k_b.mT + q_b @ k_s.mT + q_b @ k_b.mT) * d ** -0.5
    rows, keys = torch.arange(s)[:, None], torch.arange(s)[None]
    visible = torch.ones((s, s), dtype=torch.bool)
    if causal:
        visible &= keys <= rows
    if window is not None:
        visible &= rows - keys < window
    logits = logits.masked_fill(~visible, -np.inf)
    top = logits.amax(-1, keepdim=True).nan_to_num(0.0, neginf=0.0)
    p = torch.exp(logits - top).float()
    p_b = WM.round_tf32(p)
    p_s = WM.round_tf32(p - p_b) if three else torch.zeros_like(p)
    o = p_s.double() @ v_b + p_b.double() @ v_s + p_b.double() @ v_b
    total = p.double().sum(-1, keepdim=True)
    return (o / torch.where(total == 0, 1.0, total)).float()


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "b,h,kv,s,causal,window",
    [
        (1, 2, 2, 70, True, None),
        (2, 4, 2, 100, True, 30),  # GQA and a window
        (1, 4, 1, 64, False, None),
        (1, 2, 1, 40, True, 0),  # every row sees no key
    ],
)
def test_three_tf32_products_meet_the_attention_tolerance(d, b, h, kv, s, causal, window):
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, kv, s, d))
    got = _tf32_attention(q, k, v, causal=causal, window=window)
    plain = FA.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, plain, **F32_TOL)
    if window == 0:
        assert not got.any()
    else:  # one TF32 product each would not
        one = _tf32_attention(q, k, v, causal=causal, window=window, three=False)
        assert not torch.allclose(one, plain, **F32_TOL)


# ---------------------------------------------------------------------------
# every entry point
# ---------------------------------------------------------------------------


def _stream():
    return np.zeros((4, 2), np.int32)


NO_CARD_CALLS = {
    "stream_toggle_count": lambda: stream_toggle_count(_stream()),
    "stream_toggle_count_i64": lambda: stream_toggle_count_i64(_stream()),
    "stream_activity": lambda: stream_activity(_stream(), 16),
    "ws_matmul": lambda: ws_matmul(np.ones((2, 2), np.int8), np.ones((2, 2), np.int8)),
    "flash_attention": lambda: flash_attention(*_qkv(1, 1, 1, 8, 32)),
}


@pytest.mark.parametrize("entry", sorted(NO_CARD_CALLS))
def test_cuda_engine_raises_without_a_card(monkeypatch, entry):
    """``engine="cuda"`` is the default and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="engine='torch'"):
        NO_CARD_CALLS[entry]()

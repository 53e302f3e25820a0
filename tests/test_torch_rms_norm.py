"""L4, the row norm and the q/k norm-and-rotate, on the CPU: its plain
versions against the models' torch route (``layers.rms_norm``,
``layers.apply_rope``) bit for bit, on contiguous rows, the einsum's
permuted q/k view and the strided slices of Mamba's x_proj product; the
kernel's row layout and contract (``fits``) and the route
(``layers.norm_route``); ``blocks._qkv`` unchanged on the CPU.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.rms_norm import kernel as L4
from repro_torch.kernels.rms_norm import qk_rope, rms_norm
from repro_torch.models import blocks, layers

DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [16, 128, 256, 4096]
LAYOUTS = ["contiguous", "permuted", "slice"]


def _rows(layout: str, width: int, dtype, seed: int = 0) -> torch.Tensor:
    """(B, H, S, width) rows: contiguous; the einsum's (B, S, H, width)
    product seen as (B, H, S, width); or a slice of a wider product, as
    Mamba's dt, B and C of x_proj's (..., dt_rank + 2 N) (a row stride of
    width + 32 elements, offset 16)."""
    gen = torch.Generator().manual_seed(seed)
    b, h, s = 2, 3, 5

    def draw(*shape):
        return (3 * torch.randn(shape, generator=gen)).to(dtype)

    if layout == "contiguous":
        return draw(b, h, s, width)
    if layout == "permuted":
        return draw(b, s, h, width).permute(0, 2, 1, 3)
    return draw(b, h, s, width + 32)[..., 16:16 + width]


def _weight(width: int, dtype, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (1 + 0.5 * torch.randn(width, generator=gen)).to(dtype)


def _tables(b: int, s: int, width: int):
    return layers.rope_angles(torch.arange(3, 3 + s).expand(b, s), width, 1e6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_rms_norm_is_the_torch_route(dtype, width, layout):
    """The plain version rounds as ``layers.rms_norm``'s float32 chain does,
    bit for bit, and writes contiguous rows of x's type."""
    x, w = _rows(layout, width, dtype), _weight(width, dtype)
    got = L4.rms_norm_fwd_plain(x, w)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, layers.rms_norm(x, w))
    assert torch.equal(L4.rms_norm_fwd(x, w, 1e-6), got)  # CPU: the plain version
    assert torch.equal(rms_norm(x, w, engine="torch"), got)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "rope_only"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_qk_rope_is_rms_norm_then_apply_rope(dtype, width, layout, norm):
    """The q/k pass's plain version against the torch route's two steps:
    ``rms_norm`` (rounded to x's type) then ``apply_rope``, bit for bit;
    without a weight, RoPE alone; without tables, the norm alone."""
    x = _rows(layout, width, dtype)
    w = _weight(width, dtype) if norm else None
    cos, sin = _tables(x.shape[0], x.shape[2], width)
    want = layers.rms_norm(x, w) if norm else x
    rotated = layers.apply_rope(want, cos, sin)
    got = L4.qk_rope_fwd_plain(x, w, cos, sin)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, rotated)
    assert torch.equal(L4.qk_rope_fwd(x, w, cos, sin), rotated)
    assert torch.equal(qk_rope(x, w, cos, sin, engine="torch"), rotated)
    if norm:
        assert torch.equal(L4.qk_rope_fwd(x, w, None, None), want)


def test_cpu_calls_launch_nothing():
    before = (L4.rms_norm_fwd.launches, L4.qk_rope_fwd.launches)
    x = _rows("permuted", 128, torch.bfloat16)
    cos, sin = _tables(2, 5, 128)
    L4.rms_norm_fwd(x, _weight(128, torch.bfloat16))
    L4.qk_rope_fwd(x, None, cos, sin)
    assert (L4.rms_norm_fwd.launches, L4.qk_rope_fwd.launches) == before


@pytest.mark.parametrize("layout,dims,strides", [
    ("contiguous", (1, 1, 30), (0, 0, 128)),
    ("permuted", (2, 3, 5), (1920, 128, 384)),  # (B, H, S) of a (B, S, H, 128) product
    ("slice", (1, 1, 30), (0, 0, 160)),
])
def test_row_layout_merges_nested_dims(layout, dims, strides):
    x = _rows(layout, 128, torch.float32)
    assert L4.row_layout(x) == (dims, strides)


def test_row_layout_gives_up_beyond_three_dims():
    x = torch.randn(2, 3, 4, 5, 8).permute(3, 0, 2, 1, 4)
    assert L4.row_layout(x) is None
    assert not L4.fits(x)
    assert L4.fits(x.contiguous())


@pytest.mark.parametrize("case,want", [
    ("bf16", True), ("f32", True), ("f16", False), ("f64", False),
    ("odd_width", False), ("width_not_whole_vectors", False), ("too_wide", False),
    ("misaligned_slice", False), ("aligned_slice", True), ("strided_last_dim", False),
    ("bf16_weight_f32_rows", True), ("f16_weight", False),
])
def test_fits_takes_only_what_the_kernel_reads_in_place(case, want):
    """The contract: bf16 or float32, whole 16-byte vectors within the
    maximum, the last dim contiguous, 16-byte aligned rows."""
    x, w = torch.randn(6, 64), None
    if case == "bf16":
        x = x.bfloat16()
    elif case in ("f16", "f64"):
        x = x.to(torch.float16 if case == "f16" else torch.float64)
    elif case == "odd_width":
        x = torch.randn(6, 63)
    elif case == "width_not_whole_vectors":
        x = torch.randn(6, 68).bfloat16()  # 68 bf16: 8.5 vectors
    elif case == "too_wide":
        x = torch.randn(2, 4 * L4.MAX_VECTORS + 4)
    elif case == "misaligned_slice":
        x = torch.randn(6, 80)[:, 2:66]  # 8 bytes off its 16-byte bound
    elif case == "aligned_slice":
        x = torch.randn(6, 80)[:, 4:68]
    elif case == "strided_last_dim":
        x = torch.randn(6, 128)[:, ::2]
    elif case == "bf16_weight_f32_rows":
        w = torch.ones(64, dtype=torch.bfloat16)
    elif case == "f16_weight":
        w = torch.ones(64, dtype=torch.float16)
    assert L4.fits(x, w) is want


@pytest.mark.parametrize("hd,dtype,want", [
    (128, torch.bfloat16, True), (64, torch.float32, True), (8, torch.float32, True),
    (8, torch.bfloat16, False),  # a half of 4 bf16 is not a whole vector
    (1024, torch.bfloat16, False),  # a half beyond a warp's 32 vectors
    (512, torch.bfloat16, True),
])
def test_fits_the_rotation(hd, dtype, want):
    x = torch.randn(1, 2, 3, hd).to(dtype)
    cos, sin = _tables(1, 3, hd)
    assert L4.fits(x, None, cos, sin, rotate=True) is want
    assert not L4.fits(x, None, cos.bfloat16(), sin.bfloat16(), rotate=True)


@pytest.mark.parametrize("case", ["cpu", "cpu_under_grad", "odd_width", "misaligned_slice"])
def test_norm_route_keeps_the_torch_route_off_the_card(case):
    """No CPU tensor takes L4, with or without a gradient to take, at any
    width; an odd width and a misaligned slice are outside the kernel's
    contract on any device (``fits``)."""
    x, w = torch.randn(4, 64), torch.ones(64)
    if case == "cpu_under_grad":
        w.requires_grad_()
    elif case == "odd_width":
        x, w = torch.randn(4, 63), torch.ones(63)
        assert not L4.fits(x, w)
    elif case == "misaligned_slice":
        x = torch.randn(4, 72)[:, 2:66]
        assert not L4.fits(x, w)
    assert layers.norm_route(x, w) == "torch"
    with torch.no_grad():
        assert layers.norm_route(x, w) == "torch"


def test_wrapper_checks_its_operands():
    x = torch.randn(2, 3, 4, 16)
    cos, sin = _tables(2, 4, 16)
    with pytest.raises(ValueError):
        L4.rms_norm_fwd(x, torch.ones(8))
    with pytest.raises(ValueError):
        L4.qk_rope_fwd(x, None, None, None)
    with pytest.raises(ValueError):
        L4.qk_rope_fwd(x, None, cos[:, :3], sin[:, :3])
    with pytest.raises(ValueError):
        L4.qk_rope_fwd(x[0], None, cos, sin)
    with pytest.raises(ValueError):
        L4.rms_norm_fwd(x, torch.ones(16, device="meta"))


def _attention_case(arch: str, **changes):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    gen = torch.Generator().manual_seed(7)
    p = blocks.Attention(gen, cfg, None).stage(None)
    if cfg.qk_norm:  # weights away from one, so that the norm's weight shows
        p = dict(p, q_norm=1 + 0.3 * torch.randn(cfg.head_dim, generator=gen),
                 k_norm=1 + 0.3 * torch.randn(cfg.head_dim, generator=gen))
    x = torch.randn(2, 9, cfg.d_model, generator=gen)
    return cfg, p, x


@pytest.mark.parametrize("arch,changes", [
    ("qwen3_8b", {}),  # qk_norm and RoPE
    ("mixtral_8x7b", {}),  # RoPE alone
    ("qwen3_8b", {"rope_kind": "none"}),  # qk_norm alone
    ("yi_6b", {"rope_kind": "none"}),  # neither
])
def test_qkv_on_the_cpu_is_unchanged(arch, changes):
    """``_qkv`` on the CPU takes the torch route: q and k equal the q/k
    norms (``rms_norm``) then ``apply_rope``, as it computed them before
    L4, bit for bit; no L4 counter moves."""
    cfg, p, x = _attention_case(arch, **changes)
    positions = torch.arange(9).expand(2, 9)
    cos, sin = blocks._rope_tables(cfg, positions)
    with torch.inference_mode(), obs.tracing():
        q, k, v = blocks._qkv(p, x, cfg, cos, sin)
        counters = obs.counters()
    assert "norm.kernel_calls" not in counters and "rope.kernel_calls" not in counters
    wq, wk = p["wq"], p["wk"]
    want_q = torch.einsum("bsd,dhk->bhsk", x, wq)
    want_k = torch.einsum("bsd,dhk->bhsk", x, wk)
    if cfg.qk_norm:
        want_q = layers.rms_norm(want_q, p["q_norm"])
        want_k = layers.rms_norm(want_k, p["k_norm"])
    if cos is not None:
        want_q = layers.apply_rope(want_q, cos, sin)
        want_k = layers.apply_rope(want_k, cos, sin)
    assert torch.equal(q, want_q) and torch.equal(k, want_k)
    assert torch.equal(v, torch.einsum("bsd,dhk->bhsk", x, p["wv"]))

"""The tiling of the port's conv kernel (``ops/conv.py::plan_conv``) and its
packed weight layout (``pack_weights``), which the CUDA kernel
``csrc/gated_conv_elu.cu`` reads as they are: planned and packed on the CPU
here, run on the card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from uncertainty_model_tpu_torch.ops import conv as tconv

LIMIT = 232448  # shared memory a block may use on an H100

# (H, W, C, Co, k): the flagship's convs at 256x512: the s2d stages' gated
# interiors and the native encoder's interiors enc0-enc4
S2D = {"s2d_enc0": (64, 128, 128, 128, 5), "s2d_enc1": (32, 64, 256, 256, 3)}
NATIVE = {
    "enc0": (128, 256, 32, 32, 7),
    "enc1": (64, 128, 64, 64, 5),
    "enc2": (32, 64, 128, 128, 3),
    "enc3": (16, 32, 256, 256, 3),
    "enc4": (8, 16, 512, 512, 3),
}


def _kib(nbytes):
    return -(-nbytes // 1024) * 1024


def _check_plan(plan, h, w, c, co, k, inputs=0):
    assert plan.smem <= LIMIT
    assert plan.rows * plan.tw == 256 and plan.tw in (8, 16, 32)
    assert plan.n in (32, 64, 128) and (plan.n >= co or plan.n == 128)
    assert c % plan.kc == 0 and plan.kc in (16, 32, 64)
    assert 2 <= plan.stages <= 8
    assert 3 <= plan.ring <= 8 if inputs else plan.ring == 0
    pixels = -(-(plan.rows + k - 1) * (plan.tw + k - 1) // 8) * 8
    piece = {0: 0, 1: 128, 2: 64, 3: 40, 4: 32}[inputs]
    assert plan.smem == (1024 + plan.stages * _kib(plan.n * plan.kc * 2)
                         + 2 * _kib(pixels * plan.kc * 2)
                         + _kib(plan.ring * inputs * piece * plan.kc * 2)
                         + 8 * (2 * plan.stages + 4))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("stage", sorted(S2D))
def test_plan_holds_the_s2d_stages(stage, n):
    """Every (stage, inputs) shape of the s2d serving forward has a bf16
    plan within a block's shared memory, the gated stager's ring of raw
    input pieces included."""
    h, w, c, co, k = S2D[stage]
    plan = tconv.plan_conv("gated_conv_elu", torch.bfloat16, h, w, c, co, k, n)
    _check_plan(plan, h, w, c, co, k, n)
    assert plan.kc == 64 and plan.n == 128 and plan.stages >= 4
    # a tile that wastes no pixel at these grids
    assert h % plan.rows == 0 and w % plan.tw == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stage", sorted(NATIVE))
def test_plan_holds_the_native_interiors(stage, dtype):
    """enc0-enc4, enc4 (3x3, C 512) included: the halo is held one
    64-channel chunk at a time, so C no longer bounds shared memory."""
    h, w, c, co, k = NATIVE[stage]
    plan = tconv.plan_conv("conv_elu", getattr(torch, dtype), h, w, c, co, k)
    if dtype == "float32":
        assert plan.smem == k * (32 + k - 1) * (c + 4) * 4 <= LIMIT
    else:
        _check_plan(plan, h, w, c, co, k)


@pytest.mark.parametrize("dtype,c,co", [("bfloat16", 8, 16), ("bfloat16", 32, 40),
                                        ("float32", 6, 8)])
def test_plan_refuses_untiled_channels(dtype, c, co):
    mult = 16 if dtype == "bfloat16" else 4
    with pytest.raises(ValueError, match=f"multiples of {mult}"):
        tconv.plan_conv("conv_elu", getattr(torch, dtype), 8, 8, c, co, 3)


def test_plan_refuses_what_shared_memory_cannot_hold():
    """A 31x31 kernel's halo chunk (46x46 pixels by 64 channels, twice) is
    more than a block has; the message names the bytes."""
    with pytest.raises(ValueError, match="shared memory"):
        tconv.plan_conv("conv_elu", torch.bfloat16, 8, 16, 64, 16, 31)


@pytest.mark.parametrize("h,w,rows,tw", [(64, 128, 16, 16), (8, 16, 16, 16),
                                         (3, 100, 8, 32), (40, 5, 32, 8)])
def test_plan_picks_the_tile_that_wastes_least(h, w, rows, tw):
    """Fewest output pixels past the edges first, then the fewest halo
    pixels to stage."""
    plan = tconv.plan_conv("conv_elu", torch.bfloat16, h, w, 64, 64, 3)
    assert (plan.rows, plan.tw) == (rows, tw)


def _unpack(packed, k, c, co, n, kc):
    """The inverse of the kernel's layout, from the description in
    ``pack_weights``: slice (tile, chunk, tap) of n x kc, K-major, 16-byte
    unit u of the slice stored at u ^ ((u >> 3) & (kc / 8 - 1))."""
    tiles = -(-co // n)
    slices = packed.reshape(tiles, c // kc, k * k, n * kc // 8, 8).numpy()
    u = np.arange(n * kc // 8)
    dense = slices[:, :, :, u ^ ((u >> 3) & (kc // 8 - 1))]
    dense = dense.reshape(tiles, c // kc, k, k, n, kc)
    w = np.zeros((k, k, c, tiles * n), dense.dtype)
    for t in range(tiles):
        for q in range(c // kc):
            w[:, :, q * kc:(q + 1) * kc, t * n:(t + 1) * n] = \
                dense[t, q].transpose(0, 1, 3, 2)
    assert not w[..., co:].any()
    return w[..., :co]


@pytest.mark.parametrize("k,c,co,n,kc", [(3, 64, 64, 64, 64), (5, 128, 128, 128, 64),
                                         (7, 32, 32, 32, 32), (3, 48, 48, 64, 16),
                                         (3, 64, 144, 128, 64), (3, 16, 16, 32, 16)])
def test_pack_weights_is_the_kernels_layout(k, c, co, n, kc):
    """Every weight lands once where the kernel reads it; the Co tile's
    padding is zero."""
    w = torch.from_numpy(np.random.default_rng(k + c + co).normal(
        size=(k, k, c, co)).astype(np.float32))
    packed = tconv.pack_weights(w, n, kc)
    assert packed.shape == (-(-co // n) * n * k * k * c,)
    np.testing.assert_array_equal(_unpack(packed, k, c, co, n, kc), w.numpy())


def test_packed_weights_are_made_once_per_tensor():
    """Cached per weight tensor, made again after an in-place change, and
    dropped with the tensor."""
    w = torch.randn(3, 3, 32, 32).bfloat16()
    plan = tconv.plan_conv("conv_elu", torch.bfloat16, 8, 16, 32, 32, 3)
    first = tconv._packed_weights(w, plan)
    assert tconv._packed_weights(w, plan) is first
    w.mul_(2)
    again = tconv._packed_weights(w, plan)
    assert again is not first
    torch.testing.assert_close(again, tconv.pack_weights(w, plan.n, plan.kc),
                               rtol=0, atol=0)
    key = (id(w), plan.n, plan.kc)
    assert key in tconv._PACKED
    del w
    assert key not in tconv._PACKED


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_conv_elu_wrapper_on_cpu_runs_plain_and_counts_no_launch(dtype):
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt)

    xs = [t(2, 8, 12, 16) for _ in range(3)]
    gates, w, b = torch.rand(3), t(3, 3, 16, 32) * 0.1, torch.rand(32)
    before = (tconv.gated_conv_elu.launches, tconv.conv_elu.launches)
    got = tconv.gated_conv_elu(xs, gates, w, b, width=9)
    assert (tconv.gated_conv_elu.launches, tconv.conv_elu.launches) == before
    torch.testing.assert_close(
        got, tconv.gated_conv_elu_plain(xs, gates, w, b, width=9), rtol=0,
        atol=0)
    assert got.shape == (2, 6, 9, 32) and got.dtype == dt

"""Which kernel of ``kernels/flash_attention.py`` takes a shape, on the
host (no card, no JAX).

* ``forward_route`` mirrors ``csrc/flash_attention.cu``'s ``launch_hd``:
  vd = hd <= 64 on ``mma.sync`` ("mma"); vd = hd in (64, 128] (the dense
  models' 128) on ``flash_fwd_kernel_wgmma128`` ("wgmma128", 128-row
  query tiles); vd != hd with vd <= 128 and hd <= 256 on
  ``flash_fwd_kernel_wgmma`` ("wgmma"); vd = hd in (128, 256] (gemma-2b's
  256) on ``flash_fwd_kernel_wgmma256`` ("wgmma256", the scores once per
  tile pair); the rest (hd = vd > 256, vd > 128 at vd != hd) on the
  128-column slices of ``flash_fwd_kernel_wide``;
* ``bwd_route`` picks the backward: ``flash_attention_bwd`` (vd = hd <=
  64), ``flash_attention_bwd_128`` (vd = hd in (64, 128]),
  ``flash_attention_bwd_256`` (vd = hd in (128, 256]) or
  ``flash_attention_bwd_vd`` (vd != hd, hd <= 192, vd <= 128), and raises
  for the rest;
* the wrappers' guards: the backward kernels run on CUDA tensors only,
  and ``flash_attention_bwd_128`` and ``_256`` refuse the other routes'
  shapes.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    _image_tile, bwd_route, flash_attention_bwd, flash_attention_bwd_128,
    flash_attention_bwd_256, forward_route,
)


@pytest.mark.parametrize("hd,vd,route", [
    (32, 32, "mma"), (64, 64, "mma"), (65, 65, "wgmma128"),
    (96, 96, "wgmma128"), (100, 100, "wgmma128"), (128, 128, "wgmma128"),
    (129, 129, "wgmma256"), (160, 160, "wgmma256"), (192, 192, "wgmma256"),
    (200, 200, "wgmma256"), (256, 256, "wgmma256"),
    (257, 257, "wide"), (320, 320, "wide"), (512, 512, "wide"),
    (24, 16, "wgmma"), (192, 128, "wgmma"), (96, 128, "wgmma"),
    (256, 128, "wgmma"), (160, 64, "wgmma"),
    (320, 256, "wide"), (257, 128, "wide"), (128, 129, "wide"),
    (256, 192, "wide"),
])
def test_forward_route(hd, vd, route):
    assert forward_route(hd, vd) == route


@pytest.mark.parametrize("hd,route", [
    (32, "flash_attention_bwd"), (64, "flash_attention_bwd"),
    (65, "flash_attention_bwd_128"), (100, "flash_attention_bwd_128"),
    (128, "flash_attention_bwd_128"), (129, "flash_attention_bwd_256"),
    (160, "flash_attention_bwd_256"), (192, "flash_attention_bwd_256"),
    (256, "flash_attention_bwd_256"),
])
def test_bwd_route_at_vd_equal_hd(hd, route):
    assert bwd_route(hd, hd) == route


@pytest.mark.parametrize("hd,vd", [(24, 16), (192, 128), (96, 128),
                                   (64, 32), (160, 64)])
def test_bwd_route_at_v_own_head_dim(hd, vd):
    assert bwd_route(hd, vd) == "flash_attention_bwd_vd"


@pytest.mark.parametrize("hd,vd", [(257, 257), (512, 512), (320, 256),
                                   (200, 128), (192, 160), (256, 128)])
def test_bwd_route_raises_where_no_kernel_takes_it(hd, vd):
    with pytest.raises(ValueError, match="no backward kernel"):
        bwd_route(hd, vd)


def test_flash_attention_bwd_256_guards():
    q = k = v = out = torch.zeros((1, 2, 8, 256))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd_256(q, k, v, out, out, lse)
    # the vd = hd entry point hands 256 over, and keeps the device rule
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd(q, k, v, out, out, lse)
    small = torch.zeros((1, 2, 8, 128))
    with pytest.raises(ValueError, match=r"vd = hd in \(128, 256\]"):
        flash_attention_bwd_256(small, small, small, small, small, lse)
    with pytest.raises(ValueError, match="head_dim 512 > 256"):
        big = torch.zeros((1, 2, 8, 512))
        flash_attention_bwd(big, big, big, big, big, lse)


def test_flash_attention_bwd_128_guards():
    q = k = v = out = torch.zeros((1, 6, 8, 128))
    lse = torch.zeros((1, 6, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd_128(q, k, v, out, out, lse)
    # the vd = hd entry point hands 128 over, and keeps the device rule
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_bwd(q, k, v, out, out, lse)
    for hd in (64, 129):     # the other wgmma route's and the mma route's
        t = torch.zeros((1, 6, 8, hd))
        with pytest.raises(ValueError, match=r"vd = hd in \(64, 128\]"):
            flash_attention_bwd_128(t, t, t, t, t, lse)
    with pytest.raises(ValueError, match=r"vd = hd in \(128, 256\]"):
        flash_attention_bwd_256(q, k, v, out, out, lse)


@pytest.mark.parametrize("hd,stages", [(65, 4), (100, 4), (128, 4),
                                       (129, 8), (256, 8)])
def test_image_tile_bytes(hd, stages):
    """A 64-row tile's image: one 16 KB stage of TF32 hi and lo atoms per
    32 columns of the padded width (128 or 256)."""
    assert _image_tile(hd) == stages * 16384

"""Tests of the port's CUDA kernels; they need a card (marker ``cuda``) and
skip themselves elsewhere. Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

* the device rule: a CUDA tensor launches the kernel (its launch counter
  rises) and never takes the plain version;
* each kernel against its plain version on the card over ragged shapes,
  f32 and bf16 (tolerance: f32 1e-5 — the kernel and the plain version
  sum in other orders; bf16 3e-2 — one rounding step of O(1) outputs);
* the wrapper guards hold on CUDA tensors too; a bad cluster id is flagged
  on the card and raised by ``check_cluster_ids``.
"""
import pytest
import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.fed_mix import fed_mix
from repro_torch.kernels.fed_mix_sparse import (
    check_cluster_ids, fed_mix_segment,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    backend.use_full_f32()
    return torch.Generator(device="cuda").manual_seed(0)


def _segment_args(gen, d, p, L, dtype):
    kw = dict(device="cuda", generator=gen)
    ids = torch.randint(0, L, (d,), dtype=torch.int32, **kw)
    w_new = torch.rand(d, **kw) / d
    w_old = torch.rand(d, **kw) / d
    return (ids, w_new, w_old, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def _dense_args(gen, d, p, dtype):
    kw = dict(device="cuda", generator=gen)
    mn, mo = torch.rand((d, d), **kw), torch.rand((d, d), **kw)
    tot = (mn + mo).sum(dim=1, keepdim=True)
    return (mn / tot, mo / tot, torch.randn((d, p), **kw).to(dtype),
            torch.randn((d, p), **kw).to(dtype))


def test_cuda_tensor_launches_kernel_not_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(ref, "fed_mix_segment_ref", refuse)
    monkeypatch.setattr(ref, "fed_mix_ref", refuse)
    n0 = fed_mix_segment.launches
    out = fed_mix_segment(*_segment_args(cuda, 6, 9, 3, torch.float32),
                          num_segments=3)
    torch.cuda.synchronize()
    assert fed_mix_segment.launches == n0 + 1 and out.is_cuda
    n0 = fed_mix.launches
    out = fed_mix(*_dense_args(cuda, 6, 9, torch.float32))
    torch.cuda.synchronize()
    assert fed_mix.launches == n0 + 1 and out.is_cuda


@pytest.mark.parametrize("d,p,L", [(1, 1, 1), (7, 130, 3), (37, 1000, 37),
                                   (37, 1001, 5), (100, 4099, 10),
                                   (1000, 130, 1000), (2048, 257, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_segment_matches_plain_on_card(cuda, d, p, L, dtype):
    args = _segment_args(cuda, d, p, L, dtype)
    got = fed_mix_segment(*args, num_segments=L)
    want = ref.fed_mix_segment_ref(*args, num_segments=L)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("d,p", [(1, 1), (7, 130), (37, 1000), (100, 4099),
                                 (300, 513)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_mix_matches_plain_on_card(cuda, d, p, dtype):
    args = _dense_args(cuda, d, p, dtype)
    got = fed_mix(*args)
    want = ref.fed_mix_ref(*args)
    assert got.dtype == dtype and got.shape == (d, p)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_fed_mix_segment_unaligned_view_on_card(cuda):
    """A contiguous view 4 bytes off an 8-byte boundary takes the
    one-column-a-thread path and is still right."""
    d, p = 9, 64
    base = torch.randn(2, d * p + 1, device="cuda", generator=cuda)
    xn, xo = base[0, 1:].view(d, p), base[1, 1:].view(d, p)
    ids, wn, wo, _, _ = _segment_args(cuda, d, p, 3, torch.float32)
    got = fed_mix_segment(ids, wn, wo, xn, xo, num_segments=3)
    want = ref.fed_mix_segment_ref(ids, wn, wo, xn, xo, num_segments=3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,p,L", [(6, 12, 3), (6, 13, 3), (1000, 130, 1000)])
def test_bad_cluster_ids_flagged_on_card(cuda, d, p, L):
    """A bad id is not read back at the launch: its row comes out NaN, the
    other rows are right, and ``check_cluster_ids`` raises once."""
    ids, wn, wo, xn, xo = _segment_args(cuda, d, p, L, torch.float32)
    check_cluster_ids()
    bad = ids.clone()
    bad[0], bad[-1] = L, -1
    got = fed_mix_segment(bad, wn, wo, xn, xo, num_segments=L)
    keep = torch.ones(d, dtype=torch.bool, device="cuda")
    keep[0] = keep[-1] = False
    want = ref.fed_mix_segment_ref(ids, wn * keep, wo * keep, xn, xo,
                                   num_segments=L)
    assert torch.isnan(got[0]).all() and torch.isnan(got[-1]).all()
    torch.testing.assert_close(got[1:-1], want[1:-1], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="outside \\[0, num_segments\\)"):
        check_cluster_ids(torch.device("cuda"))
    check_cluster_ids()      # the flag was cleared


def test_guards_on_card(cuda):
    ids, wn, wo, xn, xo = _segment_args(cuda, 6, 12, 3, torch.float32)
    with pytest.raises(ValueError, match="must be contiguous"):
        fed_mix_segment(ids, wn, wo, xn[:, ::2], xo[:, ::2], num_segments=3)
    with pytest.raises(ValueError, match="several devices"):
        fed_mix_segment(ids, wn, wo, xn, xo.cpu(), num_segments=3)
